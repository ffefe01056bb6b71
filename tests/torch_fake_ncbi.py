"""A fake NCBI for the tests: `urllib.request.urlopen` served from canned
records, with no network.

FakeNCBI(records) answers the two requests that utils/ncbi_neighbors.py
makes for a taxid: the neighbors table (with its "## Columns:" header,
one row a record, the accession taken from the record's FASTA header)
and efetch batches, each holding the asked accessions' records in the
order asked.  Any other URL raises AssertionError at once, so a test
that forgets to serve something fails instead of waiting on a network.
`extra` maps more URLs to their bytes; `urls` lists every URL asked for,
in order.  `install(monkeypatch)` puts it in place of urlopen for both
packages, whose modules look the function up at each call (without
`monkeypatch`, for good: in a child process of its own).  chip_smoke.py
phase 27 serves its download on the card from it too.
"""

import gzip
import io
import urllib.parse
import urllib.request

NEIGHBORS = "https://www.ncbi.nlm.nih.gov/genomes/GenomesGroup.cgi"
EFETCH = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/efetch.fcgi"
COLUMNS = ("## Columns:\tRepresentative\tNeighbor\tHost\tSelected lineage\t"
           "Taxonomy name\tSegment name")


def read_records(path, n=None):
    """The first n (header, sequence) records of a FASTA file (gzipped
    or not), headers without '>', sequences joined."""
    opener = gzip.open if path.endswith(".gz") else open
    recs = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if n is not None and len(recs) == n:
                    break
                recs.append([line[1:], []])
            elif recs:
                recs[-1][1].append(line)
    return [(h, "".join(s)) for h, s in recs]


def write_fasta(path, records, width=70):
    """records as FASTA at path, sequences wrapped at `width`."""
    with open(path, "w") as f:
        for header, seq in records:
            f.write(">" + header + "\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")
    return str(path)


class FakeNCBI:
    def __init__(self, records=(), taxid=None, segments=None, extra=None,
                 table=None):
        """records: (header, sequence) pairs, each header starting with
        its accession; taxid: the one the neighbors table answers (any
        when None); segments: each record's cell of the table's last
        column ('segment 1'; 'segment', which parses as no segment, when
        None: the table's lines are stripped, so a last cell must not be
        empty); table: the neighbors table's text in place of the one
        made from the records."""
        self.records = {h.split()[0]: (h, s) for h, s in records}
        self.order = [h.split()[0] for h, _ in records]
        self.taxid = None if taxid is None else str(taxid)
        self.segments = segments or ["segment"] * len(self.order)
        self.extra = dict(extra or {})
        self.table = table
        self.urls = []
        self.served = []   # accessions in the order efetch served them

    def neighbors_table(self):
        if self.table is not None:
            return self.table
        rows = ["## Comment line", COLUMNS]
        for acc, seg in zip(self.order, self.segments):
            rows.append("\t".join(["NC_000000", acc, "vertebrate,human",
                                   "Filoviridae,Orthoebolavirus,"
                                   "Orthoebolavirus zairense",
                                   "Zaire ebolavirus", seg]))
        return "\n".join(rows) + "\n"

    def urlopen(self, url):
        self.urls.append(url)
        if url in self.extra:
            return io.BytesIO(self.extra[url])
        base, _, query = url.partition("?")
        params = urllib.parse.parse_qs(query)
        if base == NEIGHBORS and params.get("cmd") == ["download2"] and (
                self.taxid is None or params.get("taxid") == [self.taxid]):
            return io.BytesIO(self.neighbors_table().encode())
        if base == EFETCH and params.get("db") == ["nuccore"]:
            accs = params["id"][0].split(",")
            unknown = [a for a in accs if a not in self.records]
            if unknown:
                raise AssertionError(f"efetch of unknown {unknown}")
            self.served.extend(accs)
            text = "".join(">%s\n%s\n" % self.records[a] for a in accs)
            return io.BytesIO(text.encode())
        raise AssertionError(f"no canned NCBI response for {url}")

    def served_records(self):
        return [self.records[a] for a in self.served]

    def install(self, monkeypatch=None):
        if monkeypatch is None:
            urllib.request.urlopen = self.urlopen
        else:
            monkeypatch.setattr(urllib.request, "urlopen", self.urlopen)
        return self
